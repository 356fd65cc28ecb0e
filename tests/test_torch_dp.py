"""Port parity, data-parallel training: the train bundles of
``repro_torch.launch.steps`` on the data axis of ``launch.mesh``'s host
mesh, ``dist.sharding.all_reduce_grads``, ``data.synthetic.shard_batch``,
the MoE layers' global dispatch groups and loads, and ``launch.train`` on
ranks, with checkpoints that restore across rank counts.  On the data axis
the LM states are FSDP-sharded (``dist.sharding.place``, as the
reference's rule tables say) and DeepFM's replicated.

Ranks are gloo processes on the CPU (``dist.run_ranks``): one launch for
D = 2 runs every case, one for D = 4 runs Mixtral and DeepFM.  Each case
takes 3 steps from the JAX package's state (``convert.train_state_from_numpy``,
the LMs cast to float32) on the JAX package's batches, the global batch
on every rank, each rank's state placed by ``convert``'s ``mesh=``.  The
rank targets import nothing of JAX; the JAX side runs here, in the test
process.

Bounds:

  * against the JAX package's step (the reference bundle's ``step_fn``
    under ``jax.jit`` outside a mesh context, on the global batch): the
    bounds of ``tests/test_torch_train.py``, LM float32 loss ``1e-5``,
    gnorm ``5e-4``, parameters after step 3 ``0.4`` of their update;
    recsys ``1e-5``, ``1e-5``, ``2e-3``;
  * against the port's one-rank step, float32 reassociation only:
    ``DP_BOUND``, loss ``1e-6``, gnorm ``1e-6``, parameters ``1e-3`` of
    their update (measured at D = 2 and 4 over every case: at most 1.2e-7,
    1.8e-7 and 2.8e-5).  Two controls must fail it: the step without the
    gradient mean (each rank its own rows' gradients where the data axis
    leaves a leaf whole, its FSDP shards' gradients the ranks' sum, not
    their mean; measured loss 2.7e-4 and more, gnorm 0.29 and more), and the MoE dispatch groups
    taken from the rank's own token count (Mixtral: loss 2.8e-4 at D = 2
    through its aux loss; a DeepSeek-V3 case with drops, 4 dispatch groups
    and ``capacity_factor`` 0.5, whose capacity then differs: loss 4.4e-3.
    At the reduced config no group holds more than 4 tokens, so its
    capacity of 4 drops nothing on either count, and DeepSeek-V3's loads
    come out the same);
  * exact: every rank's state after 3 steps, gathered whole
    (``launch.train.state_tree``), bit for bit; DeepSeek-V3's router biases
    equal to the one-rank run's; the collectives of each step, calls and
    bytes: for DeepFM, the count the buckets give plus the loss's sum; for
    an LM, ``launch.dryrun.derived_collectives`` (the FSDP gathers and
    reduce-scatters, one bucket of the leaves the data axis leaves whole,
    the loss, the global norm, and one loads gather for an MoE model).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import shutil
import types

import numpy as np
import pytest
import torch

import repro_torch.dist.sharding as sharding
import repro_torch.launch.steps as steps
import repro_torch.models.moe as moe
from repro_torch.ckpt import ckpt_path, latest_step
from repro_torch.configs import ARCHS
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.synthetic import graph_batch, make_batch, shard_batch
from repro_torch.dist import PartitionMesh, run_ranks
from repro_torch.dist.sharding import (
    all_reduce_grads,
    dp_axes,
    dp_size,
    fit_specs,
    lm_param_specs,
)
from repro_torch.launch import train as train_mod
from repro_torch.launch.dryrun import derived_collectives
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.launch.train import restore_state, state_digests, state_tree, train

pytestmark = pytest.mark.mesh

RANK_TIMEOUT = 300.0
N_STEPS = 3
#: the JAX bounds (tests/test_torch_train.py's LM float32 and recsys ones)
JAX_LM_F32 = dict(loss=1e-5, gnorm=5e-4, params=0.4)
JAX_F32 = dict(loss=1e-5, gnorm=1e-5, params=2e-3)
#: D ranks against the port's one-rank step (float32 reassociation; see the
#: module docstring for the readings)
DP_BOUND = dict(loss=1e-6, gnorm=1e-6, params=1e-3)
#: the gradient buckets' cap in the rank launches: several buckets a step
BUCKET_BYTES = 64 << 10
MAIN, UNSUMMED, LOCAL_GROUPS = "main", "unsummed", "local-groups"

#: name -> (arch, shape, the JAX package's step to hold it to, config changes,
#: DISPATCH_GROUPS, variants, rank counts)
CASES = {
    "tinyllama": ("tinyllama-1.1b", "train_4k", True, None, None,
                  (MAIN, UNSUMMED), (2,)),
    "mixtral": ("mixtral-8x22b", "train_4k", True, None, None,
                (MAIN, UNSUMMED, LOCAL_GROUPS), (2, 4)),
    "deepseek": ("deepseek-v3-671b", "train_4k", True, None, None, (MAIN, UNSUMMED), (2,)),
    "deepseek-drops": ("deepseek-v3-671b", "train_4k", False, {"capacity_factor": 0.5}, 4,
                       (MAIN, LOCAL_GROUPS), (2,)),
    "deepfm": ("deepfm", "train_batch", True, None, None, (MAIN, UNSUMMED), (2, 4)),
}


def _family(name: str) -> str:
    return ARCHS[CASES[name][0]].family


def _config(name: str):
    arch, _, _, changes, *_ = CASES[name]
    cfg = reduced_config(ARCHS[arch])
    if changes:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **changes))
    return cfg


# -- the cases, run on ranks and on one rank --------------------------------------


@contextlib.contextmanager
def _patched(obj, attr: str, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _unsummed(grads, params, mesh, **kw):
    """The control: each rank keeps its own gradients (its FSDP shards' the
    ranks' sum), none divided by the rank count."""
    return {n: torch.zeros_like(p) if grads.get(n) is None else grads[n]
            for n, p in params.items()}


def _variant(name: str, variant: str):
    stack = contextlib.ExitStack()
    groups = CASES[name][4]
    if groups is not None:
        stack.enter_context(_patched(moe, "DISPATCH_GROUPS", groups))
    if variant == UNSUMMED:
        stack.enter_context(_patched(steps, "all_reduce_grads", _unsummed))
    elif variant == LOCAL_GROUPS:
        real = moe.dispatch_groups
        stack.enter_context(_patched(moe, "dispatch_groups", lambda t, mesh=None: real(t)))
    return stack


def _snapshot_delta(a: dict, b: dict) -> dict:
    """The calls and bytes of each collective between two ``stats``
    snapshots (those that ran)."""
    ran = [op for op in b["calls"] if b["calls"][op] != a["calls"].get(op, 0)]
    return {k: {op: b[k][op] - a[k].get(op, 0) for op in ran} for k in ("calls", "bytes")}


def _run_case(name: str, variant: str, np_state, batches, mesh=None) -> dict:
    """3 steps of case ``name`` from ``np_state`` on ``batches`` (the
    global batches), on ``mesh``'s data axis or on one rank."""
    arch, shape = CASES[name][:2]
    family, cfg = _family(name), _config(name)
    with _variant(name, variant):
        tb = steps.build_bundle(arch, shape, reduced=True, config=cfg, device="cpu",
                                mesh=mesh)
        state = train_state_from_numpy(family, np_state, cfg, device="cpu", mesh=mesh)
        losses, gnorms, per_step = [], [], []
        for b in batches:
            before = None if mesh is None else mesh.data.stats.snapshot()
            state, m = tb.step_fn(state, {k: torch.as_tensor(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
            if mesh is not None:
                per_step.append(_snapshot_delta(before, mesh.data.stats.snapshot()))
    params = {n: t.detach().clone() for n, t in state_tree(state)["params"].items()}
    shapes = {n: tuple(p.shape) for n, p in state["params"].named_parameters()}
    placed = getattr(state["params"], "placement", None)
    lead = mesh is None or mesh.rank == 0
    return {"losses": losses, "gnorms": gnorms, "per_step": per_step,
            "digests": state_digests(state), "count": int(state["opt"]["count"]),
            "params": params if lead else None, "shapes": shapes,
            "specs": None if placed is None else placed.specs,
            "biases": {n: p for n, p in params.items() if n.endswith("router_bias")}}


def _grads_unit(mesh) -> dict:
    """``all_reduce_grads`` alone: bfloat16 and float32, a gradient that is
    None on rank 0 only, a transposed one, buckets of 16 bytes."""
    r = mesh.rank
    gen = torch.Generator().manual_seed(100 + r)
    params = {"w": torch.zeros(5, 3, dtype=torch.bfloat16), "gone": torch.zeros(7),
              "t": torch.zeros(6, 4), "v": torch.zeros(10)}
    grads = {"w": torch.randn(5, 3, generator=gen).to(torch.bfloat16),
             "gone": None if r == 0 else torch.randn(7, generator=gen),
             "t": torch.randn(4, 6, generator=gen).T, "v": torch.randn(10, generator=gen)}
    inputs = {k: None if g is None else g.clone() for k, g in grads.items()}
    before = mesh.data.stats.snapshot()
    with _patched(sharding, "GRAD_BUCKET_BYTES", 16):
        out = all_reduce_grads(grads, params, mesh.data)
    return {"inputs": inputs, "out": out,
            "delta": _snapshot_delta(before, mesh.data.stats.snapshot()),
            "in_place": out["v"].data_ptr() == grads["v"].data_ptr()}


def _dp_rank(cases: dict) -> dict:
    """One rank of a launch: every case and variant of ``cases`` (name ->
    (numpy state, batches, variants))."""
    sharding.GRAD_BUCKET_BYTES = BUCKET_BYTES
    mesh = make_host_mesh(device="cpu")
    out = {"grads_unit": _grads_unit(mesh), "shape": mesh.shape, "rank": mesh.rank}
    for name, (np_state, batches, variants) in cases.items():
        for variant in variants:
            out[name, variant] = _run_case(name, variant, np_state, batches, mesh)
    return out


# -- the JAX package's side --------------------------------------------------------


def _jax_case(name: str):
    """The JAX package's initial state and batches (numpy), and its 3 steps
    under ``jax.jit`` outside a mesh context: ``(np_state, batches, metrics,
    its final parameters in the port's layout)``."""
    import jax
    import jax.numpy as jnp

    from repro.data.synthetic import make_batch as jax_make_batch
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro.launch.steps import build_bundle as jax_build_bundle

    arch, shape, with_jax = CASES[name][:3]
    jb = jax_build_bundle(arch, shape, jax_host_mesh(), reduced=True)
    js = jb.init_state_fn(jax.random.PRNGKey(0))
    if _family(name) == "lm":
        js = jax.tree.map(
            lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, js)
    np_state = jax.tree.map(np.asarray, js)
    batches = [jax.tree.map(np.asarray, jax_make_batch(jb.abstract_inputs, seed=0, step=i,
                                                       bounds=jb.input_bounds))
               for i in range(N_STEPS)]
    if not with_jax:
        return np_state, batches, None, None
    step = jax.jit(jb.step_fn)
    metrics = []
    for b in batches:
        js, m = step(js, b)
        metrics.append((float(m["loss"]), float(m["gnorm"])))
    end = train_state_from_numpy(_family(name), jax.tree.map(np.asarray, js), _config(name),
                                 device="cpu")
    return np_state, batches, metrics, dict(end["params"].named_parameters())


@pytest.fixture(scope="module")
def runs():
    """Every case: the JAX package's steps, the port's one-rank steps, and
    each rank count's launch."""
    inputs, out = {}, {}
    for name in CASES:
        np_state, batches, jm, j_end = _jax_case(name)
        inputs[name] = (np_state, batches)
        model = train_state_from_numpy(_family(name), np_state, _config(name),
                                       device="cpu")["params"]
        grad_bytes: dict = {}  # dtype -> the bytes of the gradients a step sums
        for p in model.parameters():
            if p.requires_grad:
                grad_bytes[p.dtype] = grad_bytes.get(p.dtype, 0) + p.numel() * p.element_size()
        out[name] = {"jax": (jm, j_end), "grad_bytes": grad_bytes,
                     "one": _run_case(name, MAIN, np_state, batches),
                     "start": {n: p.detach().clone() for n, p in model.named_parameters()}}
    launches = {}
    for d in (2, 4):
        cases = {name: (*inputs[name], CASES[name][5]) for name in CASES if d in CASES[name][6]}
        launches[d] = run_ranks(_dp_rank, d, device="cpu", timeout=RANK_TIMEOUT,
                                args=(cases,))
    return out, launches


def _d_cases():
    return [(name, d) for name in CASES for d in CASES[name][6]]


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


@pytest.mark.parametrize("name, d", _d_cases(), ids=[f"{n}-D{d}" for n, d in _d_cases()])
def test_ranks_match_jax_and_the_one_rank_step(runs, name, d):
    """D ranks against the JAX package's no-mesh step and against the
    port's one-rank step, on the same global batches."""
    out, launches = runs
    got = launches[d][0][name, MAIN]
    assert got["count"] == N_STEPS and launches[d][0]["shape"] == {"data": d, "model": 1}
    jm, j_end = out[name]["jax"]
    start = out[name]["start"]
    if jm is not None:
        _check(got, jm, j_end, start, JAX_LM_F32 if _family(name) == "lm" else JAX_F32)
    _check(got, *_one_rank_ref(out[name]["one"]), start, DP_BOUND)


@pytest.mark.parametrize("name, d", _d_cases(), ids=[f"{n}-D{d}" for n, d in _d_cases()])
def test_ranks_stay_identical_and_the_controls_fail(runs, name, d):
    """Every rank's state after 3 steps, gathered whole, equals rank 0's bit
    for bit; each control of the case fails ``DP_BOUND`` against the
    one-rank step."""
    out, launches = runs
    ranks = launches[d]
    for variant in CASES[name][5]:
        digests = [r[name, variant]["digests"] for r in ranks]
        if variant == MAIN:
            assert all(g == digests[0] for g in digests[1:])
            continue
        with pytest.raises(AssertionError):
            _check(ranks[0][name, variant], *_one_rank_ref(out[name]["one"]),
                   out[name]["start"], DP_BOUND)


def test_router_biases_equal_the_one_rank_run(runs):
    """DeepSeek-V3's aux-free biases after 3 steps on 2 ranks equal the
    one-rank run's bit for bit: each step's loads are the global batch's,
    summed over the groups in their global order."""
    out, launches = runs
    for name in ("deepseek", "deepseek-drops"):
        one, got = out[name]["one"], launches[2][0][name, MAIN]
        assert one["biases"]
        for n, b in one["biases"].items():
            assert torch.equal(got["biases"][n], b), (name, n)
            assert not torch.equal(b, out[name]["start"][n])


@pytest.mark.parametrize("name, d", _d_cases(), ids=[f"{n}-D{d}" for n, d in _d_cases()])
def test_collectives_per_step_equal_the_derived_count(runs, name, d):
    """Each step's calls and bytes.  DeepFM (replicated): one all-reduce a
    bucket (the gradients of one dtype end to end, cut every
    ``BUCKET_BYTES``) and one for the loss.  An LM (FSDP over the data
    axis): the count derived from its specs (``derived_collectives``)."""
    out, launches = runs
    cfg = _config(name)
    if _family(name) == "lm":
        got = launches[d][0][name, MAIN]
        with _variant(name, MAIN):  # the case's DISPATCH_GROUPS
            groups = moe.dispatch_groups(4 * 32) if cfg.moe else None
        with _patched(sharding, "GRAD_BUCKET_BYTES", BUCKET_BYTES):  # the ranks' buckets
            want = derived_collectives(
                cfg, "train", got["specs"], got["shapes"], {"data": d, "model": 1},
                batch=4, seq=32, groups=groups,
                frozen=frozenset(n for n in got["specs"] if n.endswith("router_bias")))
        want_calls, want_bytes = want["calls"]["data"], want["bytes"]["data"]
    else:
        grads = out[name]["grad_bytes"]
        buckets = sum(math.ceil(b / BUCKET_BYTES) for b in grads.values())
        want_calls = {"all_reduce": buckets + 1}
        want_bytes = {"all_reduce": sum(grads.values()) + 4}
    for r in launches[d]:
        for step in r[name, MAIN]["per_step"]:
            assert step["calls"] == want_calls
            assert all(step["bytes"][op] == b for op, b in want_bytes.items())


@pytest.mark.parametrize("d", [2, 4])
def test_all_reduce_grads_means_every_bucket(runs, d):
    """bfloat16 and float32 buckets of 16 bytes (a tensor split across
    two), a gradient None on one rank summed as zeros, a transposed one,
    the result written back in place: the mean of the ranks' gradients."""
    _, launches = runs
    res = [r["grads_unit"] for r in launches[d]]
    for k in ("w", "gone", "t", "v"):
        terms = [r["inputs"][k] for r in res if r["inputs"][k] is not None]
        want = sum(t.float() for t in terms) / d
        for r in res:
            got = r["out"][k]
            assert got.dtype == (torch.bfloat16 if k == "w" else torch.float32)
            tol = 1e-2 if k == "w" else 1e-6
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
            assert torch.equal(got, res[0]["out"][k])
    # 30 bytes of bfloat16 and 164 of float32, in 16-byte buckets
    assert all(r["delta"]["calls"] == {"all_reduce": 2 + 11} for r in res)
    assert all(r["in_place"] for r in res)


# -- the pieces, without ranks -------------------------------------------------------


def _fake_mesh(d: int, rank: int) -> HostMesh:
    return HostMesh(PartitionMesh(d, rank, torch.device("cpu"), None))


def test_host_mesh_outside_a_group_is_one_rank():
    mesh = make_host_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
    assert dp_axes(mesh) == ("data",) and dp_size(mesh) == 1 and mesh.rank == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_host_mesh()


def test_train_defaults_to_one_rank_outside_a_group(monkeypatch):
    """``train()`` without ``ranks`` runs one rank outside a process group,
    however many cards the host shows: no ranks are started, and the
    result keeps its ``final_state`` (a GNN bundle, which ranks cannot run,
    included)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def no_ranks(*a, **k):
        raise AssertionError("train() started ranks it was not asked for")

    monkeypatch.setattr(train_mod, "_train_ranks", no_ranks)
    monkeypatch.setattr(train_mod, "run_ranks", no_ranks)
    seen = []
    real = train_mod._train_here
    monkeypatch.setattr(train_mod, "_train_here",
                        lambda mesh, **kw: seen.append(mesh) or {"device": kw["device"]})
    assert train("pna", "full_graph_sm", steps=1, verbose=False) == {"device": "cuda"}
    assert seen == [None]
    monkeypatch.setattr(train_mod, "_train_here", real)
    out = train("pna", "full_graph_sm", steps=2, verbose=False, device="cpu")
    assert "ranks" not in out and len(out["losses"]) == 2
    assert isinstance(out["final_state"]["params"], torch.nn.Module)


def test_shard_batch_takes_each_ranks_rows():
    batch = {"tokens": torch.arange(24).reshape(6, 4), "labels": torch.arange(6)}
    parts = [shard_batch(batch, _fake_mesh(3, r)) for r in range(3)]
    for k in batch:
        assert torch.equal(torch.cat([p[k] for p in parts]), batch[k])
    assert torch.equal(parts[1]["labels"], torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="cannot be split over 4"):
        shard_batch(batch, _fake_mesh(4, 0))


def test_recsys_batch_is_replicated_where_the_ranks_do_not_divide_it():
    """The reference's recsys specs: rows over the data ranks where they
    divide the batch, the whole batch on every rank otherwise."""
    batch = {"ids": torch.arange(8)[:, None, None], "labels": torch.arange(8.0)}
    assert shard_batch(batch, _fake_mesh(3, 2), replicate_uneven=True) is batch
    assert torch.equal(shard_batch(batch, _fake_mesh(4, 3), replicate_uneven=True)["labels"],
                       torch.tensor([6.0, 7.0]))


def test_dispatch_groups_split_the_global_groups():
    assert moe.dispatch_groups(64) == 32
    assert moe.dispatch_groups(64, _fake_mesh(2, 1)) == 16  # 32 global groups
    assert moe.dispatch_groups(32, _fake_mesh(4, 0)) == 8
    with pytest.raises(ValueError, match="cannot split evenly"):
        moe.dispatch_groups(11, _fake_mesh(3, 0))  # 33 tokens make 11 groups


@pytest.mark.parametrize("arch, shape, what", [
    ("pna", "full_graph_sm", "512 nodes"), ("meshgraphnet", "minibatch_lg", "512 nodes"),
    ("mace", "molecule", "512 nodes"), ("dimenet", "molecule", "512 nodes"),
])
def test_bundles_not_on_the_data_axis_raise_on_ranks(arch, shape, what):
    """The GNN bundles run on the flattened axis: on a 2-rank mesh each
    builds, places its (replicated) state and shards its graph batch over
    the ranks; on 3 ranks, which cannot split the graph, it raises."""
    tb = steps.build_bundle(arch, shape, reduced=True, mesh=_fake_mesh(2, 1))
    state = tb.init_state_fn(0)
    assert all(ax is None for spec in state["params"].placement.specs.values() for ax in spec)
    inputs = tb.abstract_inputs
    n = (inputs.get("x") or inputs["species"]).shape[0]
    batch = graph_batch(inputs, seed=0, step=0, n_nodes=n, device="cpu")
    mine = shard_batch(batch, _fake_mesh(2, 1))
    half = inputs["edge_src"].shape[0] // 2
    assert torch.equal(mine["edge_src"], batch["edge_src"][half:])
    assert mine["label_mask" if "label_mask" in batch else "graph_id"].shape[0] == n // 2
    with pytest.raises(ValueError, match=what):
        steps.build_bundle(arch, shape, reduced=True, mesh=_fake_mesh(3, 0))


def test_one_rank_mesh_is_the_one_device_step():
    """``mesh=`` of one rank and ``train(ranks=1)`` give today's results bit
    for bit (DeepSeek-V3 in bfloat16: MoE, MTP, router biases)."""
    arch, shape = "deepseek-v3-671b", "train_4k"
    tb0 = steps.build_bundle(arch, shape, reduced=True, device="cpu")
    tb1 = steps.build_bundle(arch, shape, reduced=True, mesh=make_host_mesh(device="cpu"))
    s0, s1 = tb0.init_state_fn(0), tb1.init_state_fn(0)
    for i in range(2):
        b = make_batch(tb0.abstract_inputs, seed=0, step=i, bounds=tb0.input_bounds,
                       device="cpu")
        s0, m0 = tb0.step_fn(s0, b)
        s1, m1 = tb1.step_fn(s1, b)
        assert float(m0["loss"]) == float(m1["loss"]) and float(m0["gnorm"]) == float(m1["gnorm"])
    assert state_digests(s0) == state_digests(s1)
    a = train(arch, shape, steps=2, verbose=False, device="cpu")
    b = train(arch, shape, steps=2, verbose=False, device="cpu", ranks=1)
    assert a["losses"] == b["losses"]
    assert state_digests(a["final_state"]) == state_digests(b["final_state"])
    with pytest.raises(ValueError, match="not the mesh's"):
        steps.build_bundle(arch, shape, reduced=True, device="cuda",
                           mesh=make_host_mesh(device="cpu"))


def test_tensor_digest_sees_one_bit_and_a_swap():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    d = train_mod.tensor_digest(t)
    flipped = t.clone()
    flipped.view(torch.int32)[1, 2] ^= 1
    swapped = t.clone().reshape(-1)[[1, 0, *range(2, 12)]].reshape(3, 4)
    assert train_mod.tensor_digest(t.clone()) == d
    assert train_mod.tensor_digest(flipped)[0] != d[0]
    assert train_mod.tensor_digest(swapped)[0] == d[0]
    assert train_mod.tensor_digest(swapped)[1] != d[1]
    assert train_mod.tensor_digest(torch.tensor([-0.0]))[0] != train_mod.tensor_digest(
        torch.tensor([0.0]))[0]


# -- the trainer on ranks ------------------------------------------------------------


TRAIN = ("deepseek-v3-671b", "train_4k")


def _file_digests(path: str) -> dict:
    """The digests of a checkpoint's tensors, restored onto a fresh state."""
    state = steps.build_bundle(*TRAIN, reduced=True, device="cpu").init_state_fn(1)
    restore_state(path, state)
    return state_digests(state)


def test_trainer_on_two_ranks_restarts_bit_for_bit_and_onto_one(tmp_path):
    """2 ranks, 6 steps straight against a crash at step 4 and a restart
    from step 3's checkpoint: the crash raises the one-rank message, the
    restart takes the same losses and ends in the same state, bit for bit,
    on both ranks.  Then the straight run's last checkpoint restores onto
    one rank: the tensors are the checkpoint's, which are the 2-rank
    state's."""
    kw = dict(steps=6, ckpt_every=3, verbose=False, device="cpu", ranks=2)
    straight, crashy = str(tmp_path / "straight"), str(tmp_path / "crashy")
    ref = train(*TRAIN, ckpt_dir=straight, **kw)
    assert ref["ranks"] == 2 and ref["backend"] == "gloo" and ref["ranks_identical"]
    assert len(ref["losses"]) == len(ref["gnorms"]) == 6 and ref["resumed_from"] is None
    # each step's FSDP gathers and its loads gather, then three checkpoints'
    # whole-state gathers (every data-split leaf, and both its moments)
    model = steps.build_bundle(*TRAIN, reduced=True, device="cpu").init_state_fn(0)["params"]
    standin = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((2, 1)))
    specs = fit_specs(lm_param_specs(model), model, standin)
    local = {n: tuple(s // (2 if ax == "data" else 1) for s, ax in zip(p.shape, specs[n]))
             for n, p in model.named_parameters()}
    per_step = derived_collectives(model.cfg, "train", specs, local, {"data": 2, "model": 1},
                                   batch=4, seq=32, groups=moe.dispatch_groups(4 * 32),
                                   elts={n: p.element_size()
                                         for n, p in model.named_parameters()})
    n_split = sum("data" in spec for spec in specs.values())
    assert ref["stats"]["calls"]["all_gather"] == (
        6 * per_step["calls"]["data"]["all_gather"] + 3 * 3 * n_split)
    with pytest.raises(RuntimeError, match="^injected crash at step 4$"):
        train(*TRAIN, ckpt_dir=crashy, crash_at=4, **kw)
    assert latest_step(crashy) == 3
    out = train(*TRAIN, ckpt_dir=crashy, **kw)
    assert out["resumed_from"] == 3 and out["ranks_identical"]
    assert out["losses"] == ref["losses"][3:] and out["digests"] == ref["digests"]
    assert latest_step(crashy) == 6

    one_dir = tmp_path / "one"
    one_dir.mkdir()
    shutil.copy(ckpt_path(straight, 6), ckpt_path(str(one_dir), 6))
    assert ref["digests"] == _file_digests(ckpt_path(straight, 6))
    kw = dict(ckpt_dir=str(one_dir), verbose=False, device="cpu", ranks=1)
    restored = train(*TRAIN, steps=6, **kw)  # no step left: the restored state comes back
    assert restored["resumed_from"] == 6 and restored["losses"] == []
    assert state_digests(restored["final_state"]) == ref["digests"]
    one = train(*TRAIN, steps=8, **kw)
    assert one["resumed_from"] == 6 and len(one["losses"]) == 2


def test_trainer_restores_a_one_rank_checkpoint_on_two_ranks(tmp_path):
    ck = str(tmp_path / "ck")
    one = train(*TRAIN, ckpt_dir=ck, steps=3, verbose=False, device="cpu")
    assert state_digests(one["final_state"]) == _file_digests(ckpt_path(ck, 3))
    # on two ranks with no step left, every rank's final state is the restored one
    two = train(*TRAIN, ckpt_dir=ck, steps=3, verbose=False, device="cpu", ranks=2)
    assert two["resumed_from"] == 3 and two["ranks_identical"] and two["losses"] == []
    assert two["digests"] == state_digests(one["final_state"])
    assert latest_step(ck) == 3


def test_train_cli_runs_on_two_ranks(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    train_mod.main(["--arch", "mixtral-8x22b", "--shape", "train_4k", "--device", "cpu",
                    "--ranks", "2", "--steps", "2", "--ckpt-dir", ck])
    printed = capsys.readouterr().out
    assert "[train] step 0: loss" in printed and "[train] done; loss" in printed
    assert latest_step(ck) == 2
