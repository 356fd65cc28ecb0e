"""Port parity, the model axis and FSDP: ``launch.mesh.make_mesh``'s ``(data,
model)`` meshes, ``dist.sharding``'s fitted specs, shards and autograd
pairs, the tensor-, expert- and vocab-parallel LM and DeepFM train steps of
``launch.steps`` with FSDP over ``data``, the LM prefill on the model axis,
and checkpoints that restore across layouts.

Ranks are gloo processes on the CPU (``dist.run_ranks``): one launch for
each mesh, ``(1, 2)`` and ``(2, 2)``, runs every case.  Each train case
takes 2 steps from the JAX package's state (``convert.train_state_from_numpy``
with ``mesh=``, the LMs cast to float32) on the JAX package's batches, the
global batch on every rank.  The rank targets import nothing of JAX.

Bounds:

  * against the JAX package's one-device step (the reference bundle's
    ``step_fn`` under ``jax.jit`` outside a mesh context): the bounds of
    ``tests/test_torch_train.py`` and ``tests/test_torch_dp.py``, LM float32
    loss ``1e-5``, gnorm ``5e-4``, parameters after step 2 ``0.4`` of their
    update; recsys ``1e-5``, ``1e-5``, ``2e-3``;
  * against the port's one-rank step, float32 reassociation only:
    ``TP_BOUND``, loss ``4e-7``, gnorm ``7e-7``, parameters ``5e-4`` of
    their update, about 4x the largest distance measured over every case
    on both meshes (loss 8.0e-8, gnorm 1.7e-7, parameters 1.2e-4).  Controls
    that must fail it: attention's ``wo`` partial sums left unsummed over
    the model axis (every LM case; measured loss 1.8e-2 and more), DeepFM's
    bags left unsummed over it (loss 0.65), and, for TinyLlama, the clip
    reading the rank's local gradient norm before the cross-rank sum
    (gnorm 0.20 and 0.42);
  * the prefill's last-position logits against the one-rank prefill's:
    ``PREFILL_SHARE`` (``1e-5``) of their rms, about 4x the measured 2.6e-6;
    TinyLlama's prefill with ``wo`` unsummed must fail it;
  * exact: each rank's parameters and moments have the shapes (and bytes)
    their fitted spec gives them; the gradients of the leaves the model
    axis leaves whole are bit-equal on every model rank; the collectives of
    each step, calls and bytes per axis, equal a count derived from the
    specs (``launch.dryrun.derived_collectives``: weight gathers and
    reduce-scatters over ``data``, the model axis's sums and gathers, the
    remat replay, each with its bytes); the prefill's
    next tokens; a checkpoint restored across layouts, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro_torch.dist.sharding as sharding
import repro_torch.launch.steps as steps
import repro_torch.models.attention as attention
import repro_torch.models.recsys.embedding as embedding
from repro_torch.configs import ARCHS
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.dist import run_ranks
from repro_torch.dist.sharding import (
    fit_specs,
    lm_param_specs,
    recsys_param_specs,
)
from repro_torch.launch.dryrun import derived_collectives
from repro_torch.launch.mesh import HostMesh, make_mesh
from repro_torch.ckpt import save_pytree
from repro_torch.launch.train import restore_state, state_digests, state_tree, tensor_digest
from repro_torch.models.recsys import DeepFM
from repro_torch.models.transformer import Transformer, _logits, gather_logits, lm_hidden
from repro_torch.optim.adamw import global_norm

pytestmark = pytest.mark.mesh

RANK_TIMEOUT = 300.0
N_STEPS = 2
MESHES = ((1, 2), (2, 2))
JAX_LM_F32 = dict(loss=1e-5, gnorm=5e-4, params=0.4)
JAX_F32 = dict(loss=1e-5, gnorm=1e-5, params=2e-3)
#: a (D, T) mesh against the port's one-rank step (see the module docstring)
TP_BOUND = dict(loss=4e-7, gnorm=7e-7, params=5e-4)
#: the prefill's last-position logits against one rank, of their rms
PREFILL_SHARE = 1e-5
MAIN, WO_UNSUMMED, BAG_UNSUMMED, LOCAL_NORM = "main", "wo-unsummed", "bag-unsummed", "local-norm"

#: name -> (arch, shape, config changes, controls)
CASES = {
    "tinyllama": ("tinyllama-1.1b", "train_4k", None, (WO_UNSUMMED, LOCAL_NORM)),
    "tinyllama-remat": ("tinyllama-1.1b", "train_4k", {"remat": True}, ()),
    "mixtral": ("mixtral-8x22b", "train_4k", None, (WO_UNSUMMED,)),
    "deepseek": ("deepseek-v3-671b", "train_4k", None, (WO_UNSUMMED,)),
    "deepfm": ("deepfm", "train_batch", None, (BAG_UNSUMMED,)),
}
PREFILL_ARCHS = ("tinyllama-1.1b", "mixtral-8x22b", "deepseek-v3-671b")
RESTORE_CASE = "deepseek"


def _family(name: str) -> str:
    return ARCHS[CASES[name][0]].family


def _config(name: str):
    arch, _, changes, _ = CASES[name]
    cfg = reduced_config(ARCHS[arch])
    return dataclasses.replace(cfg, **changes) if changes else cfg


# -- the cases, run on ranks and on one rank --------------------------------------


@contextlib.contextmanager
def _patched(obj, attr: str, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _variant(variant: str):
    stack = contextlib.ExitStack()
    if variant == WO_UNSUMMED:
        stack.enter_context(_patched(attention, "reduce_from_model", lambda x, axis: x))
    elif variant == BAG_UNSUMMED:
        stack.enter_context(_patched(embedding, "reduce_from_model", lambda x, axis: x))
    elif variant == LOCAL_NORM:
        stack.enter_context(_patched(sharding.Placement, "global_norm",
                                     lambda self, grads: global_norm(grads.values())))
    return stack


def _stats(mesh) -> dict:
    return {} if mesh is None else mesh.stats()


def _delta(a: dict, b: dict) -> dict:
    """Per axis, the calls and bytes of each collective between two
    ``HostMesh.stats`` snapshots (those that ran)."""
    out = {}
    for axis in b:
        ran = [op for op in b[axis]["calls"] if b[axis]["calls"][op] != a[axis]["calls"].get(op, 0)]
        out[axis] = {k: {op: b[axis][k][op] - a[axis][k].get(op, 0) for op in ran}
                     for k in ("calls", "bytes")}
    return out


def _run_case(name: str, variant: str, np_state, batches, mesh=None) -> dict:
    """2 steps of case ``name`` from ``np_state`` on ``batches`` (the
    global batches), on ``mesh`` or on one rank."""
    arch, shape = CASES[name][:2]
    cfg = _config(name)
    seen = {}
    real_update = steps.adamw_update

    def recording(model, grads, opt, opt_cfg):
        if "grads" not in seen:  # step 1's, as the step hands them over
            seen["grads"] = {n: tensor_digest(g) for n, g in grads.items()}
        return real_update(model, grads, opt, opt_cfg)

    with _variant(variant), _patched(steps, "adamw_update", recording):
        tb = steps.build_bundle(arch, shape, reduced=True, config=cfg, device="cpu",
                                mesh=mesh)
        state = train_state_from_numpy(_family(name), np_state, cfg, device="cpu", mesh=mesh)
        losses, gnorms, per_step = [], [], []
        for b in batches:
            before = _stats(mesh)
            state, m = tb.step_fn(state, {k: torch.as_tensor(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
            if mesh is not None:
                per_step.append(_delta(before, _stats(mesh)))
    model = state["params"]
    whole = {n: t.detach().clone() for n, t in state_tree(state)["params"].items()}
    lead = mesh is None or mesh.rank == 0
    return {"losses": losses, "gnorms": gnorms, "per_step": per_step,
            "digests": state_digests(state), "grad_digests": seen["grads"],
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "moment_shapes": {k: {n: tuple(t.shape) for n, t in state["opt"][k].items()}
                              for k in ("mu", "nu")},
            "bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "moment_bytes": sum(t.numel() * t.element_size() for k in ("mu", "nu")
                                for t in state["opt"][k].values()),
            "specs": None if mesh is None else dict(model.placement.specs),
            "params": whole if lead else None}


def _prefill(arch: str, np_params, tokens: np.ndarray, mesh=None) -> dict:
    """The prefill bundle's next tokens, and the last position's logits
    whole, from ``np_params`` in float32."""
    cfg = reduced_config(ARCHS[arch])
    model = lm_params_from_numpy(np_params, cfg, device="cpu", mesh=mesh)
    tb = steps.build_bundle(arch, "prefill_32k", reduced=True, device="cpu", mesh=mesh)
    t = torch.as_tensor(tokens)
    out = tb.step_fn({"params": model}, {"tokens": t})
    rows = t if mesh is None else t.tensor_split(mesh.shape["data"])[mesh.data.rank]
    with torch.inference_mode():
        h, _, _ = lm_hidden(model, rows, mesh=mesh)
        logits = gather_logits(model, _logits(model, h[:, -1:], mesh), mesh)[:, -1]
    return {"next_token": out["next_token"].clone(), "logits": logits.float().clone()}


def _tp_rank(d: int, t: int, cases: dict, prefill: dict, ckpt: dict) -> dict:
    """One rank of a ``(d, t)`` launch: every case and variant, the
    prefills, a checkpoint restored (``ckpt["restore"]``) and one written
    (``ckpt["save"]``)."""
    mesh = make_mesh(data=d, model=t, device="cpu")
    out = {"shape": mesh.shape, "rank": mesh.rank,
           "index": (mesh.data.rank, mesh.model.rank)}
    for name, (np_state, batches, variants) in cases.items():
        for variant in variants:
            out[name, variant] = _run_case(name, variant, np_state, batches, mesh)
    for arch, (np_params, tokens) in prefill.items():
        out["prefill", arch] = _prefill(arch, np_params, tokens, mesh)
    with _variant(WO_UNSUMMED):
        out["prefill-control"] = _prefill(PREFILL_ARCHS[0], *prefill[PREFILL_ARCHS[0]], mesh)
    if ckpt.get("restore"):  # onto the initial state, in float32 as written
        state = train_state_from_numpy("lm", cases[RESTORE_CASE][0], _config(RESTORE_CASE),
                                       device="cpu", mesh=mesh)
        restore_state(ckpt["restore"], state)
        out["restored"] = state_digests(state)
    if ckpt.get("save"):
        np_state, batches, _ = cases[RESTORE_CASE]
        arch, shape = CASES[RESTORE_CASE][:2]
        tb = steps.build_bundle(arch, shape, reduced=True, device="cpu", mesh=mesh)
        state = train_state_from_numpy("lm", np_state, _config(RESTORE_CASE), device="cpu",
                                       mesh=mesh)
        for b in batches:
            state, _ = tb.step_fn(state, {k: torch.as_tensor(v) for k, v in b.items()})
        tree = state_tree(state)  # every rank gathers; rank 0 writes
        if mesh.rank == 0:
            save_pytree(ckpt["save"], tree, step=N_STEPS)
        out["saved"] = state_digests(state)
    return out


# -- the JAX package's side --------------------------------------------------------


def _jax_case(name: str):
    """The JAX package's initial state and batches (numpy), and its steps
    under ``jax.jit`` outside a mesh context: ``(np_state, batches,
    metrics, its final parameters in the port's layout)``."""
    import jax
    import jax.numpy as jnp

    from repro.data.synthetic import make_batch as jax_make_batch
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro.launch.steps import build_bundle as jax_build_bundle

    arch, shape = CASES[name][:2]
    jb = jax_build_bundle(arch, shape, jax_host_mesh(), reduced=True)
    js = jb.init_state_fn(jax.random.PRNGKey(0))
    if _family(name) == "lm":
        js = jax.tree.map(
            lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, js)
    np_state = jax.tree.map(np.asarray, js)
    batches = [jax.tree.map(np.asarray, jax_make_batch(jb.abstract_inputs, seed=0, step=i,
                                                       bounds=jb.input_bounds))
               for i in range(N_STEPS)]
    step = jax.jit(jb.step_fn)
    metrics = []
    for b in batches:
        js, m = step(js, b)
        metrics.append((float(m["loss"]), float(m["gnorm"])))
    end = train_state_from_numpy(_family(name), jax.tree.map(np.asarray, js), _config(name),
                                 device="cpu")
    return np_state, batches, metrics, dict(end["params"].named_parameters())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the JAX package's steps, the port's one-rank steps and
    prefills, and each mesh's launch."""
    root = tmp_path_factory.mktemp("tp")
    inputs, out = {}, {}
    for name in CASES:
        np_state, batches, jm, j_end = _jax_case(name)
        inputs[name] = (np_state, batches)
        model = train_state_from_numpy(_family(name), np_state, _config(name),
                                       device="cpu")["params"]
        out[name] = {"jax": (jm, j_end), "one": _run_case(name, MAIN, np_state, batches),
                     "start": {n: p.detach().clone() for n, p in model.named_parameters()}}
    prefill, prefill_one = {}, {}
    for arch in PREFILL_ARCHS:
        name = next(n for n in CASES if CASES[n][0] == arch)
        params = inputs[name][0]["params"]
        tokens = np.random.default_rng(7).integers(0, 256, (4, 32)).astype(np.int32)
        prefill[arch] = (params, tokens)
        prefill_one[arch] = _prefill(arch, params, tokens)
    # a one-rank checkpoint of the restore case, for the (1, 2) launch
    arch, shape = CASES[RESTORE_CASE][:2]
    one_state = train_state_from_numpy("lm", inputs[RESTORE_CASE][0], _config(RESTORE_CASE),
                                       device="cpu")
    tb = steps.build_bundle(arch, shape, reduced=True, device="cpu")
    for b in inputs[RESTORE_CASE][1]:
        one_state, _ = tb.step_fn(one_state, {k: torch.as_tensor(v) for k, v in b.items()})
    one_path = str(root / "one.ckpt")
    save_pytree(one_path, state_tree(one_state), step=N_STEPS)
    launches = {}
    for d, t in MESHES:
        cases = {name: (*inputs[name], (MAIN, *CASES[name][3])) for name in CASES}
        ckpt = ({"restore": one_path} if (d, t) == (1, 2)
                else {"save": str(root / "two_by_two.ckpt")})
        launches[d, t] = run_ranks(_tp_rank, d * t, device="cpu", timeout=RANK_TIMEOUT,
                                   args=(d, t, cases, prefill, ckpt))
    return {"cases": out, "launches": launches, "prefill_one": prefill_one,
            "one_path": one_path, "one_digests": state_digests(one_state),
            "initial": inputs[RESTORE_CASE][0],
            "two_by_two": str(root / "two_by_two.ckpt")}


def _mesh_cases():
    return [(name, m) for m in MESHES for name in CASES]


def _ids(cases):
    return [f"{n}-{m[0]}x{m[1]}" for n, m in cases]


def _check(got: dict, ref_metrics, ref_params: dict, start: dict, tol: dict) -> None:
    """Loss and gnorm at every step, and every parameter after the last as
    a share of its update, within ``tol`` of the reference."""
    for (rl, rg), tl, tg in zip(ref_metrics, got["losses"], got["gnorms"]):
        np.testing.assert_allclose(tl, rl, rtol=tol["loss"])
        np.testing.assert_allclose(tg, rg, rtol=tol["gnorm"])
    for name, p in got["params"].items():
        r = ref_params[name].detach().float()
        moved = (r - start[name].float()).norm()
        diff = (p.float() - r).norm()
        if moved == 0:
            assert diff == 0, name
            continue
        assert float(diff / moved) <= tol["params"], (name, float(diff / moved))


def _one_rank_ref(one: dict):
    return list(zip(one["losses"], one["gnorms"])), one["params"]


# -- placement parity, without ranks -----------------------------------------------


def _standin(d: int, t: int):
    """A mesh as ``_fit_specs`` reads one: ``axis_names`` and ``devices``."""
    return types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((d, t)))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x22b", "deepseek-v3-671b",
                                  "granite-3-8b", "mistral-nemo-12b", "deepfm"])
@pytest.mark.parametrize("shape", [(2, 2), (16, 16)], ids=["2x2", "16x16"])
def test_fitted_specs_equal_the_references(arch, shape):
    """The port's fitted specs equal the reference's ``_fit_specs`` of its
    rule tables, leaf by leaf (a stacked ``[L, ...]`` leaf as L leaves)."""
    import jax
    from jax.sharding import PartitionSpec

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs.registry import reduced_config as jax_reduced_config
    from repro.dist.sharding import lm_param_specs as jax_lm_specs
    from repro.dist.sharding import recsys_param_specs as jax_recsys_specs
    from repro.launch.steps import _fit_specs
    from repro.models.recsys.deepfm import init_deepfm
    from repro.models.transformer import init_lm_params

    mesh = _standin(*shape)
    jcfg = jax_reduced_config(JAX_ARCHS[arch])
    cfg = reduced_config(ARCHS[arch])
    key = jax.random.PRNGKey(0)
    if arch == "deepfm":
        abstract = jax.eval_shape(lambda k: init_deepfm(k, jcfg), key)
        jspecs = jax_recsys_specs(abstract)
        model = DeepFM(cfg, device="cpu")
        specs = recsys_param_specs(model)
    else:
        abstract = jax.eval_shape(lambda k: init_lm_params(k, jcfg), key)
        jspecs = jax_lm_specs(abstract)
        model = Transformer(cfg, device="cpu")
        specs = lm_param_specs(model)
    fitted = _fit_specs(jspecs, abstract, mesh)
    want = {}
    flat_specs = jax.tree_util.tree_flatten_with_path(
        fitted, is_leaf=lambda s: isinstance(s, PartitionSpec))[0]
    for (path, leaf), (_, spec) in zip(jax.tree_util.tree_flatten_with_path(abstract)[0],
                                       flat_specs):
        keys = [str(getattr(p, "key", getattr(p, "idx", None))) for p in path]
        spec = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
        if keys[0] in ("dense_layers", "moe_layers"):
            assert spec[0] is None
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i), *keys[1:]])] = spec[1:]
        else:
            want[".".join(keys)] = spec
    got = fit_specs(specs, model, mesh)
    assert got == want
    if shape == (16, 16) and arch == "mixtral-8x22b":  # 4 experts: model dropped
        assert got["moe_layers.0.moe.we_gate"] == (None, "data", None)


def test_make_mesh_outside_a_group_and_the_host_mesh_shape():
    mesh = make_mesh(data=1, model=1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(data=1, model=2, device="cpu")
    fake = HostMesh(sharding.PartitionMesh(2, 1, torch.device("cpu"), None))
    assert fake.shape == {"data": 2, "model": 1} and fake.rank == 1


def test_fit_specs_drops_an_axis_that_does_not_divide():
    """Granite's published vocab of 49,155 over ``model = 2``: the vocab
    axis is dropped, FSDP kept."""
    shapes = {"embed": (49155, 4096), "head": (4096, 49155), "wq": (4096, 4096)}
    specs = {"embed": ("model", "data"), "head": ("data", "model"), "wq": ("data", "model")}
    got = fit_specs(specs, shapes, _standin(2, 2))
    assert got == {"embed": (None, "data"), "head": ("data", None), "wq": ("data", "model")}


# -- on the meshes ------------------------------------------------------------------


@pytest.mark.parametrize("name, mesh", _mesh_cases(), ids=_ids(_mesh_cases()))
def test_mesh_step_matches_jax_and_the_one_rank_step(runs, name, mesh):
    """A ``(D, T)`` mesh against the JAX package's one-device step and the
    port's one-rank step on the same global batches; each control of the
    case fails ``TP_BOUND``."""
    case = runs["cases"][name]
    ranks = runs["launches"][mesh]
    got = ranks[0][name, MAIN]
    assert ranks[0]["shape"] == {"data": mesh[0], "model": mesh[1]}
    jm, j_end = case["jax"]
    _check(got, jm, j_end, case["start"], JAX_LM_F32 if _family(name) == "lm" else JAX_F32)
    _check(got, *_one_rank_ref(case["one"]), case["start"], TP_BOUND)
    assert all(r[name, MAIN]["digests"] == got["digests"] for r in ranks)
    for variant in CASES[name][3]:
        with pytest.raises(AssertionError):
            _check(ranks[0][name, variant], *_one_rank_ref(case["one"]), case["start"],
                   TP_BOUND)


@pytest.mark.parametrize("name, mesh", _mesh_cases(), ids=_ids(_mesh_cases()))
def test_each_rank_holds_its_specs_share(runs, name, mesh):
    """Every parameter and both its moments have exactly the shape the
    fitted spec gives the rank (each split dimension over its axis size),
    the rank's bytes that share of the whole, and the model axis splits
    something."""
    one = runs["cases"][name]["one"]
    sizes = {"data": mesh[0], "model": mesh[1]}
    for r in runs["launches"][mesh]:
        got = r[name, MAIN]
        want = {}
        for n, full in one["shapes"].items():
            spec = got["specs"][n]
            want[n] = tuple(s // (sizes[ax] if ax else 1) for s, ax in zip(full, spec))
        assert got["shapes"] == want
        assert got["moment_shapes"] == {"mu": want, "nu": want}
        local = sum(int(np.prod(s)) for s in want.values())
        full = sum(int(np.prod(s)) for s in one["shapes"].values())
        assert got["bytes"] * full == one["bytes"] * local  # every leaf float32
        assert got["moment_bytes"] * full == one["moment_bytes"] * local
        assert any("model" in s for s in got["specs"].values())
        if _family(name) == "lm" and mesh[0] > 1:  # FSDP whenever D > 1
            assert got["specs"]["embed"] == ("model", "data")


@pytest.mark.parametrize("name, mesh", _mesh_cases(), ids=_ids(_mesh_cases()))
def test_leaves_the_model_axis_leaves_whole_get_bit_equal_gradients(runs, name, mesh):
    """Norms, ``router_bias``, the router and the MLPs: on every rank of one
    data index, the step-1 gradient AdamW receives is the same bits."""
    ranks = runs["launches"][mesh]
    specs = ranks[0][name, MAIN]["specs"]
    got = ranks[0][name, MAIN]["grad_digests"]
    whole = [n for n, s in specs.items() if "model" not in s and n in got]
    assert whole
    for r in ranks:
        peer = next(p for p in ranks if p["index"][0] == r["index"][0])
        for n in whole:
            assert r[name, MAIN]["grad_digests"][n] == peer[name, MAIN]["grad_digests"][n], n


@pytest.mark.parametrize("name, mesh", _mesh_cases(), ids=_ids(_mesh_cases()))
def test_collectives_per_step_equal_the_derived_count(runs, name, mesh):
    ranks = runs["launches"][mesh]
    got0 = ranks[0][name, MAIN]
    cfg = _config(name)
    want = derived_collectives(cfg, "train", got0["specs"], got0["shapes"],
                               {"data": mesh[0], "model": mesh[1]},
                               batch=4 if _family(name) == "lm" else 8, seq=32,
                               frozen=frozenset(n for n in got0["specs"]
                                                if n.endswith("router_bias")))
    for r in ranks:
        for step in r[name, MAIN]["per_step"]:
            for axis in ("data", "model"):
                assert step[axis]["calls"] == want["calls"][axis], (axis, step[axis]["calls"])
                for op, b in want["bytes"][axis].items():
                    assert step[axis]["bytes"][op] == b, (axis, op)


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_prefill_on_the_model_axis_matches_one_rank(runs, arch, mesh):
    """The prefill's next tokens (the global batch's, on every rank) equal
    the one-rank prefill's; its last-position logits lie within
    ``PREFILL_SHARE`` of their rms."""
    one = runs["prefill_one"][arch]
    for r in runs["launches"][mesh]:
        got = r["prefill", arch]
        assert torch.equal(got["next_token"], one["next_token"])
        ref = one["logits"].tensor_split(mesh[0])[r["index"][0]]
        bound = PREFILL_SHARE * float(ref.square().mean().sqrt())
        assert float((got["logits"] - ref).abs().max()) <= bound
        if arch == PREFILL_ARCHS[0]:
            control = r["prefill-control"]["logits"]
            assert float((control - ref).abs().max()) > bound


def test_checkpoints_restore_across_layouts(runs):
    """A ``(2, 2)`` checkpoint restores on one rank, and a one-rank
    checkpoint on ``(1, 2)``, bit for bit (digests of the whole state)."""
    saved = runs["launches"][2, 2][0]["saved"]
    assert all(r["saved"] == saved for r in runs["launches"][2, 2])
    state = train_state_from_numpy("lm", runs["initial"], _config(RESTORE_CASE), device="cpu")
    assert state_digests(state) != saved
    restore_state(runs["two_by_two"], state)
    assert state_digests(state) == saved
    for r in runs["launches"][1, 2]:
        assert r["restored"] == runs["one_digests"]
    # the (2, 2) state is the one-rank state up to reassociation, not bitwise
    assert saved != runs["one_digests"]
